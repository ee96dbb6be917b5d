"""Model FLOP utilisation of the train step: the configuration's train
FLOP per image (3x the forward's linear, convolution and attention
products, from `benchmark/cost`; recomputation not counted) times the
images of the window's steps, over the window's wall time, over the bf16
peak of every chip used. It never reads what the program launched."""

from benchmark import cost

LAYER = "train step (train/steps.py, train/optim.py)"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "train_img_per_s"
BETTER = "higher"


def compute(ctx):
    w = ctx["window"]
    flop = cost.train_flops_per_image(ctx["config"]) * w["images"]
    return 100.0 * flop / w["wall_s"] / (cost.BF16_FLOPS * ctx["chips"])
