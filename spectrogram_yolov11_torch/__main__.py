"""`python -m spectrogram_yolov11_torch [detect] train|val|predict k=v ...` and
`... serve model=...`: the port's command line (cfg/__init__.py:entrypoint),
on the card unless device=cpu. Logs at INFO to stderr, as the JAX CLI does."""

import json
import logging
import sys

from .cfg import entrypoint

if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    result = entrypoint()
    if isinstance(result, dict):  # val's and train's results_dict
        print(json.dumps(result))
    elif isinstance(result, list):  # predict's Results
        for r in result:
            print(f"{r.path}: {r.verbose() or 'no detections'}")
    sys.exit(0)
