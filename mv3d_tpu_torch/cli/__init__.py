"""Command-line entry points of the port; each runs on the card unless
given ``--device cpu``:

    python -m mv3d_tpu_torch.cli.train -n tag -i 10000 --kitti-object DIR
    python -m mv3d_tpu_torch.cli.test test_mv3d -n tag --kitti-object DIR
    python -m mv3d_tpu_torch.cli.tracking -n tag --kitti-raw ROOT --date D \
        --drive N --eval
    python -m mv3d_tpu_torch.cli.preprocess --kitti-object DIR -o OUT
    python -m mv3d_tpu_torch.cli.rehearsal --synthetic-fixture -o OUT -i 5
    python -m mv3d_tpu_torch.cli.dashboard log/
    python -m mv3d_tpu_torch.cli.export -n tag --out artifacts/
    python -m mv3d_tpu_torch.cli.serve --artifact artifacts/
"""
