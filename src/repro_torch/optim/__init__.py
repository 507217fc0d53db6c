"""Client optimizers and LR schedules (``repro.optim``): plain functions on
trees of tensors and on step counts, with the reference's formulas and
defaults."""
from repro_torch.optim.sgd import sgd_init, sgd_apply, clip_by_global_norm  # noqa: F401
from repro_torch.optim.schedules import wsd_schedule, cosine_schedule  # noqa: F401
