"""Offline evaluation of the torch port: ranking metrics and the skew check."""
from recommendit_tpu_torch.evaluation.metrics import (  # noqa: F401
    average_precision,
    batch_rank_metrics,
    coverage,
    detect_training_serving_skew,
    evaluate_model,
    intra_list_diversity,
    kl_divergence_bins,
    mrr,
    ndcg_at_k,
    precision_at_k,
    recall_at_k,
)
