"""Core DAQ math: formats, granularities, metrics, leaf policy, scale search."""
