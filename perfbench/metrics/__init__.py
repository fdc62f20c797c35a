"""Metric readers, one file per metric name: ``read(ctx)`` -> a number
or None."""
