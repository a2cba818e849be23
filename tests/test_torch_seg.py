"""FedSeg in the port against the reference on the CPU: the confusion-matrix
Evaluator, the per-pixel ignore-index loss and accuracy, the synthetic
segmentation data, the encoder-decoder (logits, one step's gradients and
new running statistics through the bridge), a 2-round FedSegAPI run from
the reference's init with its shuffles, and best-mIoU checkpoints that
both packages load.

Tolerances, each with its reason:

- the Evaluator's matrix and the synthetic arrays are integers and numpy
  draws: equal;
- the loss and accuracy sums: rtol 1e-6 (float32 sums in another order);
- the encoder-decoder: logits atol 2e-5, gradients rtol 1e-4 / atol 1e-5
  of the largest, statistics atol 1e-5. The bilinear ×2 upsampling
  (``jax.image.resize`` against ``F.interpolate``) rounds differently by
  up to ~1e-7 and the convolutions sum in another order, and BatchNorm
  divides by the batch's σ, which amplifies both;
- the 2-round run: params atol 1e-5, train rows rtol 1e-5 (measured
  1.8e-7 and 3.2e-7); the test-round metrics within 1e-3 (measured equal,
  but an argmax at a near-tie may flip a pixel or two of the 2,048
  counted: one pixel moves the pixel accuracy by 4.9e-4)."""

import numpy as np
import pytest
import torch

import fedml_tpu_torch.config as tcfg
from fedml_tpu_torch.algorithms.fedseg import FedSegAPI
from fedml_tpu_torch.bridge import from_flax, to_flax_variables
from fedml_tpu_torch.data.base import FederatedDataset
from fedml_tpu_torch.data.synthetic import synthetic_segmentation
from fedml_tpu_torch.models import create_model, split_stats
from fedml_tpu_torch.train import losses as L
from fedml_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from fedml_tpu_torch.utils.seg_metrics import Evaluator

from torch_parity import (
    flat_params, jax_round_perm_fn, private_reference_programs, reference_record, torch_threads,
    variables_digest,
)

METRICS = ("Pixel_Accuracy", "Pixel_Accuracy_Class", "Mean_Intersection_over_Union",
           "Frequency_Weighted_Intersection_over_Union")


@pytest.fixture(autouse=True, scope="module")
def _isolated(tmp_path_factory):
    """The port on one thread; the reference with a program cache and an
    executable store of its own (torch_parity.private_reference_programs)."""
    with torch_threads(1), private_reference_programs(tmp_path_factory.mktemp("exec_cache")):
        yield


def _both_evaluators(num_class, batches):
    from fedml_tpu.utils.seg_metrics import Evaluator as JaxEvaluator

    tev, jev = Evaluator(num_class, device="cpu"), JaxEvaluator(num_class)
    for gt, pred in batches:
        tev.add_batch(gt, pred)
        jev.add_batch(gt, pred)
    return tev, jev


def test_evaluator_matrix_and_metrics_equal_the_references():
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(3):
        gt = rng.integers(0, 5, size=(2, 9, 7)).astype(np.int32)
        gt[rng.random(gt.shape) < 0.1] = 255
        gt[0, 0, :2] = (-1, 7)  # out of range: not counted
        batches.append((gt, rng.integers(0, 5, size=gt.shape).astype(np.int32)))
    tev, jev = _both_evaluators(5, batches)
    assert tev.confusion_matrix.dtype == np.int64
    np.testing.assert_array_equal(tev.confusion_matrix, jev.confusion_matrix)
    for m in METRICS:
        assert getattr(tev, m)() == getattr(jev, m)(), m
    tev.reset()
    assert not tev.confusion_matrix.any()


def test_evaluator_all_ignored_and_perfect():
    gt = np.full((2, 4, 4), 255, np.int32)
    tev, jev = _both_evaluators(3, [(gt, np.zeros_like(gt))])
    assert not tev.confusion_matrix.any()
    for m in METRICS:
        np.testing.assert_equal(getattr(tev, m)(), getattr(jev, m)())
    gt = np.array([[0, 1, 2, 255]])
    tev, jev = _both_evaluators(3, [(gt, np.array([[0, 1, 2, 0]]))])
    assert tev.Pixel_Accuracy() == 1.0 and tev.Mean_Intersection_over_Union() == 1.0
    np.testing.assert_array_equal(tev.confusion_matrix, jev.confusion_matrix)


def test_pixel_loss_and_accuracy_skip_ignored_pixels_and_padded_rows():
    import jax.numpy as jnp

    from fedml_tpu.train import losses as JL

    rng = np.random.default_rng(1)
    logits = rng.normal(size=(4, 5, 6, 3)).astype(np.float32) * 2
    labels = rng.integers(0, 3, size=(4, 5, 6)).astype(np.int32)
    labels[rng.random(labels.shape) < 0.2] = 255
    mask = np.array([1, 1, 1, 0], np.float32)
    tl, jl = torch.from_numpy(logits), jnp.asarray(logits)
    got = [float(L.masked_pixel_ce(tl, torch.from_numpy(labels), torch.from_numpy(mask)))]
    got += [float(v) for v in L.masked_pixel_accuracy_stats(
        tl, torch.from_numpy(labels), torch.from_numpy(mask))]
    want = [float(JL.masked_pixel_ce(jl, jnp.asarray(labels), jnp.asarray(mask)))]
    want += [float(v) for v in JL.masked_pixel_accuracy_stats(
        jl, jnp.asarray(labels), jnp.asarray(mask))]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert L.SEG_IGNORE_INDEX == JL.SEG_IGNORE_INDEX == 255
    assert got[2] == float(np.sum(labels[:3] != 255))


def test_synthetic_segmentation_is_byte_identical():
    from fedml_tpu.data.synthetic import synthetic_segmentation as jax_seg

    kw = dict(num_clients=3, num_classes=5, image_size=12, samples_per_client=7, seed=4)
    got, want = synthetic_segmentation(**kw), jax_seg(**kw)
    for g, w in zip(got.client_x + got.client_y + [got.test_x, got.test_y],
                    want.client_x + want.client_y + [want.test_x, want.test_y], strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes()
    assert (got.name, got.num_classes) == (want.name, want.num_classes)


# ---------------------------------------------------------------- the model

SHAPE, CLASSES, WIDTH = (16, 16, 3), 4, 8


def _port_init():
    """The port's seeded init, which the reference's runs start from too
    (the reference's own ModelDef.init costs seconds of compiles)."""
    return create_model("segnet", "seg_synth", SHAPE, CLASSES, width=WIDTH).init(
        torch.Generator().manual_seed(3))


def _model_record(init):
    """The reference's train-mode logits, one step's gradients of the pixel
    loss, new statistics, and eval-mode logits on seeded inputs, from
    ``init`` (port variables)."""

    def run():
        import jax
        import jax.numpy as jnp

        from fedml_tpu.models import create_model as jax_create_model
        from fedml_tpu.train import losses as JL

        x, y, mask = _model_inputs()
        model = jax_create_model("segnet", "seg_synth", SHAPE, CLASSES, width=WIDTH)
        variables = to_flax_variables(init)

        def loss_fn(params):
            logits, new_vars = model.apply({**variables, "params": params}, jnp.asarray(x),
                                           train=True)
            return JL.masked_pixel_ce(logits, jnp.asarray(y), jnp.asarray(mask)), (
                logits, new_vars["batch_stats"])

        (_, (logits, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"])
        eval_logits = jax.jit(lambda v, x: model.apply(v, x, train=False)[0])(
            variables, jnp.asarray(x))
        return dict(logits=logits, stats=jax.device_get(stats), grads=jax.device_get(grads),
                    eval_logits=eval_logits)

    return reference_record("seg_model", dict(init=variables_digest(init)), run)


def _model_inputs():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3,) + SHAPE).astype(np.float32)
    y = rng.integers(0, CLASSES, size=(3,) + SHAPE[:2]).astype(np.int32)
    y[:, 0, :3] = 255
    return x, y, np.array([1, 1, 0], np.float32)


def test_encoder_decoder_matches_the_reference():
    init = _port_init()
    ref = _model_record(init)
    x, y, mask = _model_inputs()
    model = create_model("segnet", "seg_synth", SHAPE, CLASSES, width=WIDTH)
    assert set(from_flax(to_flax_variables(init))) == set(init)
    params, stats = split_stats(init)
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    logits, new_vars = model.apply({**p, **stats}, torch.from_numpy(x), train=True)
    assert logits.shape == (3,) + SHAPE[:2] + (CLASSES,)
    loss = L.masked_pixel_ce(logits, torch.from_numpy(y), torch.from_numpy(mask))
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    np.testing.assert_allclose(logits.detach().numpy(), ref.logits, atol=2e-5)
    want_g = flat_params(ref.grads)
    got_g = flat_params(to_flax_variables(grads)["params"])
    assert got_g.keys() == want_g.keys()
    scale = max(float(np.abs(g).max()) for g in want_g.values())
    for k in want_g:
        np.testing.assert_allclose(got_g[k], want_g[k], rtol=1e-4, atol=1e-5 * scale, err_msg=k)
    got_s = flat_params(to_flax_variables(new_vars)["batch_stats"])
    for k, want in flat_params(ref.stats).items():
        np.testing.assert_allclose(got_s[k], want, atol=1e-5, err_msg=k)
    eval_logits, _ = model.apply(init, torch.from_numpy(x), train=False)
    np.testing.assert_allclose(eval_logits.numpy(), ref.eval_logits, atol=2e-5)


# ------------------------------------------------------------ the algorithm

FED = dict(clients=3, samples=8, batch=4, rounds=2, seed=0)


def _seg_data(make):
    """3 clients of 8 16×16 images, 4 classes, some ignored pixels."""
    rng = np.random.default_rng(5)
    xs, ys = [], []
    for _ in range(FED["clients"]):
        x = rng.normal(size=(FED["samples"],) + SHAPE).astype(np.float32)
        y = rng.integers(0, CLASSES, size=(FED["samples"],) + SHAPE[:2]).astype(np.int32)
        x[..., : SHAPE[1] // 2, 0] += 3.0 * (y[:, :, : SHAPE[1] // 2] == 0)
        y[:, 0, 0] = 255
        xs.append(x)
        ys.append(y)
    return make(name="seg_synth", client_x=xs, client_y=ys, test_x=xs[0].copy(),
                test_y=ys[0].copy(), num_classes=CLASSES)


def _config(cfg_mod):
    return cfg_mod.RunConfig(
        data=cfg_mod.DataConfig(batch_size=FED["batch"]),
        fed=cfg_mod.FedConfig(client_num_in_total=FED["clients"],
                              client_num_per_round=FED["clients"], comm_round=FED["rounds"],
                              epochs=1, frequency_of_the_test=1),
        train=cfg_mod.TrainConfig(lr=0.05),
        seed=FED["seed"],
    )


@pytest.fixture(scope="module")
def fedseg_pair(tmp_path_factory):
    """The reference's 2-round FedSeg record and the port's API, both from
    the port's init and with the reference's shuffles, writing best-mIoU
    checkpoints."""
    init = _port_init()

    def run():
        import jax

        import fedml_tpu.config as jcfg
        from fedml_tpu.algorithms.fedseg import FedSegAPI as JaxFedSeg
        from fedml_tpu.data.base import FederatedDataset as JaxDataset
        from fedml_tpu.models import create_model as jax_create_model

        model = jax_create_model("segnet", "seg_synth", SHAPE, CLASSES, width=WIDTH)
        model.init = lambda rng: to_flax_variables(init)
        japi = JaxFedSeg(_config(jcfg), _seg_data(JaxDataset), model)
        japi.train()
        return dict(global_vars=jax.device_get(japi.global_vars), history=list(japi.history))

    ref = reference_record("fedseg_run", dict(FED, width=WIDTH, init=variables_digest(init)), run)
    model = create_model("segnet", "seg_synth", SHAPE, CLASSES, width=WIDTH)
    ckpt = str(tmp_path_factory.mktemp("fedseg") / "best")
    tapi = FedSegAPI(_config(tcfg), _seg_data(FederatedDataset), model, checkpoint_path=ckpt,
                     device="cpu", perm_fn=jax_round_perm_fn(FED["seed"], FED["clients"]))
    tapi.global_vars = {k: v.clone() for k, v in init.items()}
    tapi.train()
    return ref, tapi, ckpt


def test_fedseg_rounds_match_the_reference(fedseg_pair):
    ref, tapi, _ = fedseg_pair
    want = flat_params(ref.global_vars)
    got = flat_params(to_flax_variables(tapi.global_vars))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)
    assert len(tapi.history) == len(ref.history) == FED["rounds"]
    for g, w in zip(tapi.history, ref.history):
        assert g.keys() == w.keys()
        for key in ("Train/Loss", "Train/Acc"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5, err_msg=key)
        for key in ("Test/mIoU", "Test/FWIoU", "Test/Acc", "Test/Acc_class"):
            assert 0.0 <= g[key] <= 1.0
            np.testing.assert_allclose(g[key], w[key], atol=1e-3, err_msg=key)


def test_best_miou_checkpoint_loads_in_both_packages(fedseg_pair, tmp_path):
    from fedml_tpu.utils.checkpoint import load_checkpoint as jax_load
    from fedml_tpu.utils.checkpoint import save_checkpoint as jax_save

    _, tapi, ckpt = fedseg_pair
    best = max(range(FED["rounds"]), key=lambda r: (tapi.history[r]["Test/mIoU"], -r))
    assert tapi.best_miou == tapi.history[best]["Test/mIoU"]
    # the port's file in the reference's loader
    jvars, round_idx, *_ = jax_load(ckpt)
    assert round_idx == best
    meta = __import__("json").load(open(ckpt + ".json"))
    assert meta["best_miou"] == tapi.best_miou
    if best == FED["rounds"] - 1:  # the promoted model is the final one
        want = flat_params(to_flax_variables(tapi.global_vars))
        for k, v in flat_params(jvars).items():
            np.testing.assert_array_equal(v, want[k])
    # a reference-written best-mIoU checkpoint in the port's loader
    path = str(tmp_path / "ref_best")
    jax_save(path, jvars, round_idx=round_idx, extra_meta={"best_miou": 0.5})
    tvars, r2, *_ = load_checkpoint(path)
    assert r2 == round_idx and tvars.keys() == tapi.global_vars.keys()
    for k, v in from_flax(jvars).items():
        assert torch.equal(tvars[k], v)
    # and the port's writer with extra_meta round-trips in its own loader
    save_checkpoint(str(tmp_path / "port"), tvars, round_idx=3, extra_meta={"best_miou": 0.25})
    assert load_checkpoint(str(tmp_path / "port"))[1] == 3
