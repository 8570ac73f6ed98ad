"""Frozen input generators, found by the ``generator`` name of a
configuration: ``gen/<generator>.py`` defines ``make(config, seed, device)``."""
