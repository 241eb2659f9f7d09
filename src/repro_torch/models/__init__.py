"""The decoder-only text model: layers, attention, cache, blocks, model."""
