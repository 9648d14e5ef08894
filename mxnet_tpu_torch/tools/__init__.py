"""Tools of the port that run on the card: ``convbn_probe``, the probe of
the fused-conv unit's tap-accumulation form."""
