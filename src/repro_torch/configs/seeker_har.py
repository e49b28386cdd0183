"""The paper's own workloads, HAR (MHEALTH/PAMAP2-like) and bearing fault
(CWRU-like) edge classifiers, and the Seeker system knobs.

PyTorch-side copy of :mod:`repro.configs.seeker_har`: 60-sample windows at
50 Hz, 3 IMU channels, 12 classes, 12 default clusters, 20 importance
samples, corr >= 0.95 memoization, 16/12-bit quantized edge DNNs; the
bearing workload's 120-sample single-channel windows and 18 clusters.
"""
import dataclasses

from ..core.energy import EnergyCosts
from ..models.har import HARConfig

HAR = HARConfig(window=60, channels=3, n_classes=12, conv1=32, conv2=64,
                kernel=5, hidden=128)

# PAMAP2: 12 activities (protocol subset), 3 IMUs (hand/chest/ankle)
PAMAP2 = HARConfig(window=60, channels=3, n_classes=12, conv1=32, conv2=64,
                   kernel=5, hidden=128)

# Bearing fault (CWRU-like): higher sample rate -> wider window, more
# clusters (paper A.2: 15-20 clusters needed), 10 fault classes
BEARING = HARConfig(window=120, channels=1, n_classes=10, conv1=32, conv2=64,
                    kernel=7, hidden=128)


@dataclasses.dataclass(frozen=True)
class SeekerSystem:
    """System-level knobs (paper §4)."""
    n_sensors: int = 3                 # left ankle, right arm, chest
    default_clusters: int = 12
    bearing_clusters: int = 18
    sampling_points: int = 20
    corr_threshold: float = 0.95
    quant_bits: tuple[int, int] = (16, 12)
    kmeans_iters: int = 4
    sampling_iters: int = 7
    max_points_per_cluster: int = 16
    supercap_uj: float = 200.0
    predictor_window: int = 8
    costs: EnergyCosts = dataclasses.field(default_factory=EnergyCosts)


SYSTEM = SeekerSystem()
