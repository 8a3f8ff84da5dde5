from .paint import Hunyuan3DPaint, Hunyuan3DPaintPipeline, PaintConfig
from .pipeline import (Hunyuan3DShape, Hunyuan3DShapeConfig,
                       Hunyuan3DShapePipeline)

__all__ = ["Hunyuan3DPaint", "Hunyuan3DPaintPipeline", "PaintConfig",
           "Hunyuan3DShape", "Hunyuan3DShapeConfig", "Hunyuan3DShapePipeline"]
