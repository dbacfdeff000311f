from .classification import accuracy, macro_f1, auc_ovo, compute_metrics
