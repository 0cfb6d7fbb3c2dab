from .config import SlamConfig, load_config
from .resident import ResidentPipeline, make_pipeline
from .slam import LiorfPipeline

__all__ = ["SlamConfig", "load_config", "LiorfPipeline", "ResidentPipeline", "make_pipeline"]
