"""Port of ``repro.optim``: AdamW (``adamw``) and the learning-rate and
weight-decay schedules (``schedule``)."""
