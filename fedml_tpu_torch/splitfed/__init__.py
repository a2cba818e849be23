"""Split and vertical federation (port of ``fedml_tpu/splitfed/``): the
split-learning (SplitNN relay ring) and classical vertical-FL (guest and
hosts) runtimes, with explicit boundary messages through the comm stack
(``core/message.py`` S2C_SPLIT_* / *_VFL_*), their steps as plain
functions (:mod:`.programs`), activation-wire compression (:mod:`.codec`)
and the loopback federations (:mod:`.split_transport`,
:mod:`.vfl_transport`).

The transports import lazily (PEP 562), so the programs stay importable
from ``algorithms/`` without the comm stack."""

from __future__ import annotations

from fedml_tpu_torch.splitfed.codec import BOUNDARY_CODECS, ActivationCodec
from fedml_tpu_torch.splitfed.programs import (
    make_split_optimizer,
    make_splitnn_client_backward,
    make_splitnn_client_forward,
    make_splitnn_eval,
    make_splitnn_fused_step,
    make_splitnn_server_step,
    make_vfl_fused_step,
    make_vfl_party_update,
    merge_opt_state,
    merge_party_opt_states,
    split_opt_state,
    split_party_opt_states,
    vfl_guest_grad,
    vfl_party_forward,
)

_LAZY = {
    "SplitNNServerManager": "fedml_tpu_torch.splitfed.split_transport",
    "SplitNNClientManager": "fedml_tpu_torch.splitfed.split_transport",
    "run_loopback_splitnn": "fedml_tpu_torch.splitfed.split_transport",
    "VFLGuestManager": "fedml_tpu_torch.splitfed.vfl_transport",
    "VFLHostManager": "fedml_tpu_torch.splitfed.vfl_transport",
    "run_loopback_vfl": "fedml_tpu_torch.splitfed.vfl_transport",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)


__all__ = [
    "ActivationCodec",
    "BOUNDARY_CODECS",
    "SplitNNClientManager",
    "SplitNNServerManager",
    "VFLGuestManager",
    "VFLHostManager",
    "make_split_optimizer",
    "make_splitnn_client_backward",
    "make_splitnn_client_forward",
    "make_splitnn_eval",
    "make_splitnn_fused_step",
    "make_splitnn_server_step",
    "make_vfl_fused_step",
    "make_vfl_party_update",
    "merge_opt_state",
    "merge_party_opt_states",
    "run_loopback_splitnn",
    "run_loopback_vfl",
    "split_opt_state",
    "split_party_opt_states",
    "vfl_guest_grad",
    "vfl_party_forward",
]
