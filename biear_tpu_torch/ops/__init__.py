"""Signal ops of the port: ERB grid, framing, filterbank, CC feature."""
