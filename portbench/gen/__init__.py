"""Seeded data for the benchmark: genomes from a configuration's own seed,
reads from the run's seed (a frozen, vectorised copy of tools/simdata.py
with the repeat model the configurations state)."""
