"""Tools of the port: ``convbn_probe`` (the probe of the fused-conv
unit's tap-accumulation form, on the card), ``launch`` (starts the
workers of a dist job), ``im2rec``, ``op_sweep`` and ``bench_pipeline``."""
