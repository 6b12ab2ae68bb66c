"""The drivers of the traffic mixes, one a ``driver`` name."""
