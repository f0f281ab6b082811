"""The port's backbones with their layers, registered by the JAX
package's model names (`viditq_tpu/models/__init__.py:11-20`)."""

from viditq_tpu_torch.models.dit import (  # noqa: F401
    DiT, DiTBlock, DiT_XL_2, Latte, Latte_XL_2)
from viditq_tpu_torch.models.mmdit import (  # noqa: F401
    MMDiT, MMDiTBlock, rectified_flow_sample)
from viditq_tpu_torch.models.pixart import (  # noqa: F401
    PixArt, PixArtBlock, PixArt_XL_2, PixArtMS_XL_2)
from viditq_tpu_torch.models.registry import (MODELS, SCHEDULERS,  # noqa: F401
                                              build_module, register)
from viditq_tpu_torch.models.stdit import (  # noqa: F401
    STDiT, STDiT_XL_2, STDiTBlock)

register(MODELS, "STDiT-XL/2")(STDiT_XL_2)
register(MODELS, "STDiT")(STDiT)
register(MODELS, "PixArt-XL/2")(PixArt_XL_2)
register(MODELS, "PixArtMS-XL/2")(PixArtMS_XL_2)
register(MODELS, "PixArt")(PixArt)
register(MODELS, "DiT-XL/2")(DiT_XL_2)
register(MODELS, "DiT")(DiT)
register(MODELS, "Latte-XL/2")(Latte_XL_2)
register(MODELS, "Latte")(Latte)
register(MODELS, "MMDiT")(MMDiT)
