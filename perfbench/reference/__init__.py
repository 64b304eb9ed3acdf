"""Plain PyTorch and numpy references of what the timed paths compute.
They import nothing of the port and take nothing it made."""
