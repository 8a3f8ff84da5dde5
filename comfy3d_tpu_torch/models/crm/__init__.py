"""CRM: the convolutional reconstruction model (six views and CCMs → a
mesh) and CRM T2I's adapter (ports of `comfy3d_tpu/models/crm/`)."""

from .pipeline import CRMConfig, CRMModel, CRMReconPipeline
from .t2i_adapter import T2IAdapter, T2IAdapterConfig
from .unet2d import UNet2DModel, UNet2DModelConfig

__all__ = ["CRMConfig", "CRMModel", "CRMReconPipeline", "T2IAdapter",
           "T2IAdapterConfig", "UNet2DModel", "UNet2DModelConfig"]
