"""The plain PyTorch reference the port is judged by, and its lower-precision control."""
