from deadtrees_tpu_torch.visualization.helper import (
    denormalize_for_display,
    fig2img,
    show,
    show_cm,
)

__all__ = ["denormalize_for_display", "fig2img", "show", "show_cm"]
