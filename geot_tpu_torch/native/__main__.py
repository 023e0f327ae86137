"""python -m geot_tpu_torch.native — build the native runtime library."""
from geot_tpu_torch import native

if native.build(verbose=True):
    print(f"built OK; available={native.available()}")
else:
    raise SystemExit("native build failed")
