"""The yardstick's arithmetic: operations and bytes of each layer, counted
from shapes, one file per configuration (``<config>.py``), and the chip's
published peaks (``peaks.py``)."""
