"""Audio front-end: ``jnp_frontend.batch_features`` is the device path (train
step, eval step, decode CLI and the device feature cache all call it, so
decoding always runs the front-end the checkpoint was trained with —
BASELINE.json:5 "same feature parameters"); ``golden_np`` is the NumPy
parity spec it is tested against.
"""
