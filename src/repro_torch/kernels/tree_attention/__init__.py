from .ops import *  # noqa
