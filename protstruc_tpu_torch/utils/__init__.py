"""Serving utilities: length buckets and the warmed bucketed featurizer."""
