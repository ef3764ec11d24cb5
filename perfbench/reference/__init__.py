"""The plain reference of the θ step and the served request, and its
lower-precision control.  Plain PyTorch on dense matrices rebuilt from the
scipy base matrix; it imports nothing of the program."""
