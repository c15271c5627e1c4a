"""LM training runtime (the port of the JAX package's ``training``):
AdamW, int8 gradient compression, the stateless data stream, the
accumulating train step and atomic checkpoints; single-device."""
