"""Krum and Multi-Krum (``robustness/robust_aggregation.py``) against
``fedml_tpu.robustness`` on the CPU.

The same numpy-seeded stacks of client variables (a conv, a dense layer
and BatchNorm statistics, in the reference's layout and mapped to the
port's by ``bridge.from_flax``) go through both packages: the selected
client ids must be equal, and the aggregate within AGG_TOL; and the
admissibility errors. Krum's rounds are held against the reference in
test_torch_backdoor.py (the attacked slice) and test_torch_cli.py
(``--defense krum|multi_krum``)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from fedml_tpu.robustness import krum_aggregate as jax_krum_aggregate  # noqa: E402
from fedml_tpu.robustness import krum_select as jax_krum_select  # noqa: E402

from fedml_tpu_torch.bridge import from_flax, to_flax_variables  # noqa: E402
from fedml_tpu_torch.robustness import krum_aggregate, krum_scores, krum_select  # noqa: E402

from torch_parity import private_reference_programs  # noqa: E402

# |port − reference| of the aggregate: the mean of the same selected
# float32 rows (the one reduction differing is the m-row sum's order)
AGG_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _private_programs(tmp_path_factory):
    with private_reference_programs(tmp_path_factory.mktemp("exec_cache")):
        yield


def _stack(C: int, seed: int, outliers=()):
    """A reference-layout stack [C, ...] of variables; ``outliers`` rows
    are pushed far from the rest (Byzantine clients)."""
    rng = np.random.default_rng(seed)
    tree = {
        "params": {
            "conv": {"kernel": rng.normal(size=(C, 3, 3, 1, 4)), "bias": rng.normal(size=(C, 4))},
            "dense": {"kernel": rng.normal(size=(C, 36, 5)), "bias": rng.normal(size=(C, 5))},
        },
        "batch_stats": {"bn": {"mean": rng.normal(size=(C, 4)), "var": rng.random((C, 4))}},
    }
    tree = jax.tree_util.tree_map(lambda a: a.astype(np.float32), tree)
    for c in outliers:
        tree["params"]["dense"]["kernel"][c] += 25.0
    return tree


def _port_stack(tree):
    """The stack in the port's layout: each client mapped, then stacked."""
    C = tree["params"]["conv"]["bias"].shape[0]
    rows = [from_flax(jax.tree_util.tree_map(lambda a, c=c: a[c], tree)) for c in range(C)]
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


CASES = [(5, 1, 1), (5, 0, 3), (10, 1, 1), (10, 2, 3), (10, 3, 5), (12, 2, 1), (12, 4, 6)]


@pytest.mark.parametrize("C,f,m", CASES)
def test_selection_and_aggregate_equal_the_reference(C, f, m):
    tree = _stack(C, seed=C * 100 + f * 10 + m, outliers=range(f))
    port = _port_stack(tree)
    want_ids = np.asarray(jax_krum_select(jax.tree_util.tree_map(jnp.asarray, tree), f, m))
    got_ids = krum_select(port, f, m).numpy()
    np.testing.assert_array_equal(got_ids, want_ids)
    assert not set(got_ids) & set(range(f))  # the outliers are never picked
    want = jax_krum_aggregate(jax.tree_util.tree_map(jnp.asarray, tree), f, m)
    got = to_flax_variables(krum_aggregate(port, f, m))
    flat_w, _ = jax.tree_util.tree_flatten_with_path(want)
    flat_g, _ = jax.tree_util.tree_flatten_with_path(got)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=AGG_TOL, err_msg=str(path))
    # the running statistics take the unweighted mean of the selected rows
    np.testing.assert_allclose(
        got["batch_stats"]["bn"]["mean"],
        tree["batch_stats"]["bn"]["mean"][got_ids].mean(axis=0), rtol=0, atol=AGG_TOL,
    )


def test_scores_are_the_neighbour_distance_sums():
    tree = _stack(6, seed=3)
    port = _port_stack(tree)
    X = torch.cat([v.reshape(6, -1).double() for k, v in port.items()
                   if not k.startswith("batch_stats.")], dim=1)
    d = torch.cdist(X, X) ** 2
    d.fill_diagonal_(float("inf"))
    want = torch.sort(d, dim=1).values[:, : 6 - 1 - 2].sum(dim=1)
    torch.testing.assert_close(krum_scores(port, 1).double(), want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("C,f,m,match", [
    (4, 1, 1, "krum needs"),           # 2f + 3 > C
    (6, 2, 1, "krum needs"),
    (5, -1, 1, "krum needs"),
    (10, 2, 7, "multi-krum needs"),    # m > C − f − 2
    (10, 2, 0, "multi-krum needs"),
])
def test_admissibility_errors_are_the_reference_s(C, f, m, match):
    tree = _stack(C, seed=1)
    with pytest.raises(ValueError, match=match):
        jax_krum_select(jax.tree_util.tree_map(jnp.asarray, tree), f, m)
    with pytest.raises(ValueError, match=match):
        krum_select(_port_stack(tree), f, m)
