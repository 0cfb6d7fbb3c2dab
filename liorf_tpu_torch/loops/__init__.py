from . import detector
