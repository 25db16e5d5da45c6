"""FFJORD density estimation on the 2-D ring-of-Gaussians mixture.

JAX rebuild of the reference experiment (reference:
experiments/ffjord_gaussian.jl): 3 ConcatSquashLinear layers
(2->16->16->2, softplus) with the analytic Hutchinson VJP (:48-106),
Tsit5 at rtol=atol=1.4e-8, WeightDecay(1e-5)+ADAM(4e-2) (:132), lambda
annealed 2e3 -> 1e3 (:136-140). Generates samples via the reverse flow
with an exact trace at the end (:257-264).
"""

from common import parse_args, setup
from ffjord_common import run_ffjord_experiment
from regneuralde_tpu.data import load_gaussian_mixture


def main():
    args = parse_args("experiments/configs/ffjord_gaussian.yml")
    cfg, h, run_dir = setup(args, "ffjord_gaussian")
    seed = cfg.get("seed", 1999)
    train_loader, test_loader = load_gaussian_mixture(
        h["batch_size"], nsamples=4096, seed=seed)
    run_ffjord_experiment(
        args, h, run_dir, seed,
        train_loader, test_loader,
        input_dim=2, hidden=16,
        lam0=2e3, lam1=1e3, lr=4e-2,
    )


if __name__ == "__main__":
    main()
