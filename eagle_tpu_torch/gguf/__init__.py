from .constants import GGMLType, GGUFValueType, Keys, ggml_row_bytes
from .reader import GGUFReader, GGUFTensorInfo
from .writer import GGUFWriter

__all__ = ["GGMLType", "GGUFValueType", "Keys", "GGUFReader", "GGUFTensorInfo", "GGUFWriter",
           "ggml_row_bytes"]
