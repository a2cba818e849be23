"""The cross-silo message layer (port of ``fedml_tpu/core/``): the FTM1
envelope, the comm-manager template, the loopback and shared-memory
transports, the actor managers, send retry and the update codecs."""
