"""mfu: the whole step's share of the card's bf16 peak, in %: the model
operations of a step per image (``flops.step_per_image``: recomputation not
counted) times the run's img/s (its untraced window) over the peak. Layer:
whole step. Moves ``img_s``."""
from benchmark.flops import step_per_image


def read(r):
    if r.card is None or r.img_s <= 0:
        return None
    ops = step_per_image(r.cfg, r.traffic["image_size"],
                         r.traffic["step"] == "finetune")
    return 100.0 * ops * r.img_s / r.card["bf16_flops"]
