"""The paper's own edge workloads (§IV): ResNet50-V2, MobileNetV2,
InceptionV3 image classifiers served on 10 Raspberry-Pi-class hosts.

These drive the *simulator* reproduction of Table I.  Published profiles
(ImageNet top-5 accuracy, parameter memory, single-core-class inference
latency) parameterize each application class; the semantic/layer split
execution models follow §III-A of the paper:

  layer split     : K sequential fragments, full accuracy, latency is the sum
                    of fragment compute + inter-host forwarding hops.
  semantic split  : K parallel branches, latency is the max branch + merge,
                    accuracy drops (SplitNet-style limited information sharing).
  compression     : the baseline — single-host low-memory model, accuracy drop
                    comparable to semantic, no distribution.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class PaperWorkload:
    name: str
    params_mb: float           # fp32 parameter footprint
    base_latency_s: float      # full-model single-RPi-class inference latency
    accuracy: float            # ImageNet top-5 (paper reports accuracies ~90%)
    sem_accuracy_drop: float   # semantic split accuracy penalty
    comp_accuracy_drop: float  # compression baseline penalty
    n_fragments: int           # split cardinality used by both strategies


# Profiles: ResNet50V2 98MB / top-5 0.930; MobileNetV2 14MB / 0.901;
# InceptionV3 92MB / 0.937 (keras model cards); RPi4-class latencies from
# public TF-Lite benchmarks, scaled to full fp32 models.
WORKLOADS = {
    "resnet50v2": PaperWorkload("resnet50v2", 98.0, 2.20, 0.930, 0.035, 0.040, 4),
    "mobilenetv2": PaperWorkload("mobilenetv2", 14.0, 0.45, 0.901, 0.030, 0.030, 2),
    "inceptionv3": PaperWorkload("inceptionv3", 92.0, 2.60, 0.937, 0.040, 0.045, 4),
}
