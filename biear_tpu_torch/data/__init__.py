"""Data of the port: labels, the on-device anechoic synthesizer, the
``.shard`` and H5 readers and the input pipeline."""
