from .config import SlamConfig, load_config
from .slam import LiorfPipeline
