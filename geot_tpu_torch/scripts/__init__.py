"""The port's command-line scripts, the counterparts of the reference's
`scripts/train.py` and `scripts/train_dist.py`:

    python -m geot_tpu_torch.scripts.train       (train or time one model)
    python -m geot_tpu_torch.scripts.train_dist  (the GCN over several ranks)

Each runs on the card unless given `--device cpu`, and exposes
`main(argv=None, **start) -> dict`, which returns the row or the metrics
it printed.
"""
