"""YAML experiment configuration and results recording.

Same config schema as the reference (experiments/configs/*.yml:
``name``, ``seed``, ``hyperparameters{batch_size, epochs, regularize,
type, steer}``), same run-directory layout (timestamped identifier with
the regularization variant, config snapshot copied in, results.yml at the
end — reference: experiments/mnist_node.jl:16-35, 269-280).
"""

from __future__ import annotations

import datetime
import shutil
from pathlib import Path
from typing import Any, Dict, Optional


def load_config(path) -> Dict[str, Any]:
    # yaml is imported where it is used: it is an optional extra, and the
    # training package must import without it.
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def save_yaml(path, obj) -> None:
    import yaml

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(obj, f, default_flow_style=False)


def make_run_dir(
    root: str,
    experiment: str,
    regularize: bool,
    reg_type: Optional[str] = None,
    config_path: Optional[str] = None,
) -> Path:
    """results/<experiment>/<timestamp>_<variant>/ with the config copied
    in (reference: mnist_node.jl:27-35)."""
    stamp = datetime.datetime.now().isoformat(timespec="seconds")
    variant = f"{regularize}_{reg_type}" if regularize else "vanilla"
    run_dir = Path(root) / experiment / f"{stamp}_{variant}"
    run_dir.mkdir(parents=True, exist_ok=True)
    if config_path is not None and Path(config_path).exists():
        shutil.copy(config_path, run_dir / "config.yml")
    return run_dir
