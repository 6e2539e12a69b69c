"""Attack zoo factory (port of ``fedml_tpu.core.security.attack``).
Attacks are built lazily, so enabling none costs no imports."""

from __future__ import annotations


def create_attacker(attack_type: str, args):
    t = attack_type.strip().lower()
    if t == "byzantine":
        from .byzantine_attack import ByzantineAttack
        return ByzantineAttack(args)
    if t == "label_flipping":
        from .label_flipping_attack import LabelFlippingAttack
        return LabelFlippingAttack(args)
    if t == "backdoor":
        from .backdoor_attack import BackdoorAttack
        return BackdoorAttack(args)
    if t == "edge_case_backdoor":
        from .backdoor_attack import EdgeCaseBackdoorAttack
        return EdgeCaseBackdoorAttack(args)
    if t == "model_replacement":
        from .model_replacement_attack import ModelReplacementBackdoorAttack
        return ModelReplacementBackdoorAttack(args)
    if t == "lazy_worker":
        from .lazy_worker_attack import LazyWorkerAttack
        return LazyWorkerAttack(args)
    if t == "dlg":
        from .gradient_inversion import DLGAttack
        return DLGAttack(args)
    if t == "invert_gradient":
        from .gradient_inversion import InvertGradientAttack
        return InvertGradientAttack(args)
    if t == "revealing_labels":
        from .gradient_inversion import RevealingLabelsAttack
        return RevealingLabelsAttack(args)
    raise ValueError(f"unknown attack_type {attack_type!r}")
