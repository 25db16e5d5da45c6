"""FFJORD density estimation on MiniBooNE (43-D tabular data).

JAX rebuild of the reference experiment (reference:
experiments/ffjord_tabular.jl): CSL MLP 43->100->100->43 with analytic
Hutchinson VJP (:78-106,116), Tsit5 at rtol=atol=1.4e-8,
WeightDecay(1e-5)+ADAM(1e-2) (:133), lambda annealed 5e3 -> 1e3
(:137-141); logs train/test mean log-likelihood per epoch and times
reverse-flow sampling at the end (:262-268).
"""

from common import parse_args, setup
from ffjord_common import run_ffjord_experiment
from regneuralde_tpu.data import load_miniboone


def main():
    args = parse_args("experiments/configs/ffjord_tabular.yml")
    cfg, h, run_dir = setup(args, "ffjord_tabular")
    seed = cfg.get("seed", 3021)
    train_loader, test_loader = load_miniboone(h["batch_size"], seed=seed)
    run_ffjord_experiment(
        args, h, run_dir, seed,
        train_loader, test_loader,
        input_dim=43, hidden=100,
        lam0=5e3, lam1=1e3, lr=1e-2,
    )


if __name__ == "__main__":
    main()
