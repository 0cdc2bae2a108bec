"""Plain PyTorch references, one file per configuration (``<config>.py``),
and the pieces they share (``detect.py``). Nothing here imports the program."""
