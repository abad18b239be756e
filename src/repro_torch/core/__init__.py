"""KPynq core in PyTorch: distances, reference loops, engine, API."""
