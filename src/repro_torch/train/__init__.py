"""Serving export of trained weights (port of ``repro.train.quantized_serving``)."""
