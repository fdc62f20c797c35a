"""Data of the port: labels and the on-device anechoic synthesizer."""
