"""Training (port of ``repro.train``): AdamW, the trainer, checkpoints."""
