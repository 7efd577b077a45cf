"""Training: the train step and EF-int8 gradient compression."""

from . import compression, step
