"""Port of ``repro.data``: the byte and BPE tokenizers and the deterministic token pipeline."""
