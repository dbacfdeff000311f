from .sweep import evaluate_loader, statistics_pass, run_missing_sweep
