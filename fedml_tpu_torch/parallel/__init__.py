"""Attention cores (port of ``fedml_tpu/parallel/``; only the plain
``full_attention`` so far — ring and Ulysses sequence parallelism are still
to port, ROADMAP.md)."""
