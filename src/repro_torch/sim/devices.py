"""Device heterogeneity profiles (paper §5.1 / App. C); port of
``repro.sim.devices`` (numpy, the reference's draw order).

Six lognormal compute clusters spanning ~30x with WiFi-class network
speeds.  Hardware scenarios HS1-HS4 (paper §5.4): HS1 = current;
HS2/HS3/HS4 halve completion time for the top 25% / 75% / 100% fastest.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# (cluster weight, median per-sample train time [s], sigma)
DEVICE_CLUSTERS = [
    (0.10, 0.015, 0.20),   # flagship
    (0.20, 0.030, 0.25),
    (0.25, 0.060, 0.25),
    (0.20, 0.120, 0.30),
    (0.15, 0.250, 0.30),
    (0.10, 0.500, 0.40),   # low-end / IoT
]

# MobiPerf-like WiFi Mbps (down, up) lognormal medians
NET_DOWN_MED, NET_UP_MED = 40.0, 12.0


@dataclasses.dataclass
class DeviceProfile:
    cluster: int
    per_sample_time: float      # seconds of compute per trained sample
    down_mbps: float
    up_mbps: float

    def round_duration(self, n_samples: int, epochs: int, model_mbits: float) -> float:
        """Compute + communication time for one FL round on this device."""
        compute = self.per_sample_time * n_samples * epochs
        comm = model_mbits / self.down_mbps + model_mbits / self.up_mbps
        return compute + comm


def sample_profiles(n: int, rng: np.random.Generator,
                    hardware_scenario: str = "HS1") -> list[DeviceProfile]:
    weights = np.array([c[0] for c in DEVICE_CLUSTERS])
    clusters = rng.choice(len(DEVICE_CLUSTERS), size=n, p=weights / weights.sum())
    profiles = []
    for c in clusters:
        _, med, sigma = DEVICE_CLUSTERS[c]
        t = float(np.exp(np.log(med) + sigma * rng.standard_normal()))
        down = float(np.exp(np.log(NET_DOWN_MED) + 0.5 * rng.standard_normal()))
        up = float(np.exp(np.log(NET_UP_MED) + 0.5 * rng.standard_normal()))
        profiles.append(DeviceProfile(int(c), t, down, up))
    return apply_hardware_scenario(profiles, hardware_scenario)


def apply_hardware_scenario(profiles: list[DeviceProfile],
                            hardware_scenario: str) -> list[DeviceProfile]:
    """HS2-HS4 speedups on an HS1 base population; HS1 returns the input."""
    if hardware_scenario == "HS1":
        return profiles
    frac = {"HS2": 0.25, "HS3": 0.75, "HS4": 1.00}[hardware_scenario]
    speeds = np.array([p.per_sample_time for p in profiles])
    cutoff = np.quantile(speeds, frac)  # fastest `frac` portion
    return [dataclasses.replace(p, per_sample_time=p.per_sample_time / 2.0,
                                down_mbps=p.down_mbps * 2.0,
                                up_mbps=p.up_mbps * 2.0)
            if p.per_sample_time <= cutoff else p
            for p in profiles]
