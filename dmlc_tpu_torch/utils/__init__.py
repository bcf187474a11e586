"""Core utilities (reference: include/dmlc/{logging,registry,parameter}.h)."""
