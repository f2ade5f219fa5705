"""WAH bitmap indexing on the device (paper §4; Fusco et al. IMC'13)."""
from .wah import (build_wah_index, build_wah_index_numpy, decode_wah_bitmap,
                  wah_index_pipeline_actors)

__all__ = ["build_wah_index", "build_wah_index_numpy", "decode_wah_bitmap",
           "wah_index_pipeline_actors"]
