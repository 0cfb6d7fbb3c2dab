from . import keyframes
