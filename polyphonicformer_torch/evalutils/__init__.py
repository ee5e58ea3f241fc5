"""Evaluation: (D)VPQ, STQ and the image-mode runner; a copy of
``polyphonicformer_tpu/evalutils/`` over the port's native library and steps."""
from .dvpq import evaluate_dvpq, evaluate_image, save_frame
from .vpq import (
    INSTANCE_DIVISOR,
    aggregate_pq,
    apply_depth_threshold,
    compute_depth_errors,
    vpq_eval,
)
