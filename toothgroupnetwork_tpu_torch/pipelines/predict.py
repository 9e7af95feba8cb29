"""Grand-challenge adapter: jaw detection, lower-jaw +20 shift, challenge JSON
output (counterpart of toothgroupnetwork_tpu/pipelines/predict.py, which cannot
be imported without JAX). Output JSON schema:
``{"id_patient": "", "jaw": jaw, "labels": [...], "instances": [...]}``.
"""

from __future__ import annotations

import json
import os
import traceback

import numpy as np


class NpEncoder(json.JSONEncoder):
    def default(self, obj):
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        return super().default(obj)


class ScanSegmentation:
    def __init__(self, pipeline):
        self.chl_pipeline = pipeline

    @staticmethod
    def get_jaw(scan_path: str):
        """Jaw from ``<case>_<jaw>.obj`` filename, else from the obj header comment
        (predict_utils.py:63-80)."""
        try:
            _, jaw = os.path.basename(scan_path).split(".")[0].split("_")
            if jaw in ("upper", "lower"):
                return jaw
        except ValueError:
            pass
        try:
            with open(scan_path) as f:
                jaw = f.readline()[2:-1]
            if jaw in ("upper", "lower"):
                return jaw
        except Exception:
            traceback.print_exc()
        return None

    def predict(self, inputs):
        assert len(inputs) == 1, f"Expected one path, got {len(inputs)}"
        scan_path = inputs[0]
        pred_result = self.chl_pipeline(scan_path)
        jaw = self.get_jaw(scan_path)
        if jaw == "lower":
            sem = pred_result["sem"]
            sem[sem > 0] += 20
        elif jaw != "upper":
            raise ValueError(f"jaw name error for {scan_path!r}")

        labels = pred_result["sem"].astype(int).tolist()
        instances = pred_result["ins"].astype(int).tolist()
        assert len(labels) == len(instances), \
            "length of output labels and output instances should be equal"
        return labels, instances, jaw

    @staticmethod
    def write_output(labels, instances, jaw, output_path: str):
        pred_output = {
            "id_patient": "",
            "jaw": jaw,
            "labels": labels,
            "instances": instances,
        }
        with open(output_path, "w") as fp:
            json.dump(pred_output, fp, cls=NpEncoder)

    def process(self, input_path: str, output_path: str):
        labels, instances, jaw = self.predict([input_path])
        self.write_output(labels, instances, jaw, output_path)
