"""Mel front end, datasets, collation and the data loader."""
