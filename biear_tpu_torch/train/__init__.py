"""Training-side helpers of the port (input sanitisation so far)."""
