from . import metrics
