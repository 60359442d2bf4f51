"""The benchmark's plain reference: plain PyTorch and numpy, sharing no
code or data with the program under test."""
