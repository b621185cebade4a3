"""Serving: the batched engine that decodes and carries MemForest's ingest and
query lanes."""
