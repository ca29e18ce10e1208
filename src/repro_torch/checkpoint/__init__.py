"""Port of ``repro.checkpoint``: atomic, asynchronous checkpoints."""
