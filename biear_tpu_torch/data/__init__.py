"""Data of the port: labels, the on-device anechoic synthesizer and the
``.shard`` reader."""
