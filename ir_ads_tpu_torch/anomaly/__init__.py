"""The anomaly stack (the deviation network and LightSB): counterpart of
ir_ads_tpu/anomaly/, with the same public names."""

from ir_ads_tpu_torch.anomaly.deviation import AnomalyScoreNet, deviation_loss
from ir_ads_tpu_torch.anomaly.sb import (
    LightSBParams,
    get_S,
    get_drift,
    get_log_C,
    get_log_potential,
    init_lightsb,
    init_r_by_samples,
    sample_at_time_moment,
    sample_euler_maruyama,
    sample_posterior,
)

__all__ = [
    "AnomalyScoreNet",
    "LightSBParams",
    "deviation_loss",
    "get_S",
    "get_drift",
    "get_log_C",
    "get_log_potential",
    "init_lightsb",
    "init_r_by_samples",
    "sample_at_time_moment",
    "sample_euler_maruyama",
    "sample_posterior",
]
