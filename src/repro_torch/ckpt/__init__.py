"""Checkpointing (counterpart of ``repro/ckpt/``): ``checkpoint.save``,
``latest_step`` and ``restore``."""
