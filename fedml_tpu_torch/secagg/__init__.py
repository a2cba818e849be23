"""Secure aggregation (port of ``fedml_tpu/secagg/``): finite-field MPC
primitives and the pairwise-masked round protocol."""

from fedml_tpu_torch.secagg.mpc import (  # noqa: F401
    DH_SECRET_BITS,
    FIELD_PRIME,
    MODP_2048_G,
    MODP_2048_P,
    bgw_decode,
    bgw_encode,
    derive_pair_mask,
    dh_public,
    dh_secret,
    dh_shared,
    gen_additive_shares,
    gen_lagrange_coeffs,
    lcc_decode_with_points,
    lcc_encode_with_points,
    modular_inv,
)
from fedml_tpu_torch.secagg.secure_aggregation import ClientParty, ServerAggregator  # noqa: F401
