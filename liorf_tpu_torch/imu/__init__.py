from . import fusion, preintegration
