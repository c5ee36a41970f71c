from .encoder import EncoderConfig, TransformerEncoder  # noqa: F401
from .bge_m3 import BgeM3Config, BgeM3Model, M3Output  # noqa: F401
from .cross_encoder import CrossEncoderModel  # noqa: F401
