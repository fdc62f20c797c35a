"""Serving entry points of the port: batch prediction (``infer``),
streaming (``streaming``) and their profiles."""
