"""Port of ``repro.launch``: the training launcher."""
