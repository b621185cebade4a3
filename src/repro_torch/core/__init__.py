"""MemForest core: forest, trees, write path and read path."""
