"""Graph writers that a configuration names by its `"writer"` key:
writers/<name>.py with `write_graph(cfg, seed, path, threads=0) -> facts`,
loaded by benchmark/generate.py. A configuration without the key is written
by generate.py's own P-line writer."""
