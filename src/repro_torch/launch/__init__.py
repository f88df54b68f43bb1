"""Launchers (port of ``repro.launch``): ``serve`` (Seismic's serving
CLI) and ``train`` (the LM's training loop on one device)."""
