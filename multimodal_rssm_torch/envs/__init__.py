"""Interactive environments for online (Dreamer-style) training: the
port's own copy of the JAX package's ``envs/`` (it imports nothing of
that package).

The reference is an offline world-model codebase: it ships a MuJoCo
simulation only as a Docker dependency (docker/with_simulation_env/) and
never steps an environment from Python.  This package provides the
steppable-environment surface the online training loop
(multimodal_rssm_torch/train/online.py) drives:

- ``PegInsertionEnv`` — the MuJoCo peg-insertion task whose scripted
  collector produces this repo's sim dataset (the JAX package's
  collect_sim_data CLI), exposed as reset/step.
- ``SyntheticEnv`` — a dependency-free COBOTTA-schema toy task for tests
  and smoke runs.
- External-suite adapters (envs/zoo.py) — any gym/gymnasium, dm_control
  or robosuite task behind the same protocol, matching the reference sim
  image's env zoo (its Dockerfile installs those suites but ships no env
  code).  Specs: ``gym:<id>``, ``dmc:<domain>:<task>``,
  ``robosuite:<Task>``.

Env protocol (duck-typed):
  ``reset(seed) -> obs``  — dict of single-frame observations (images
  uint8 HWC at the model's input size, other modalities float32);
  ``step(action) -> (obs, reward, done)`` — action in [-1, 1]^action_size;
  attributes ``observation_names``, ``action_size``, ``length``.
"""

from multimodal_rssm_torch.envs.synthetic import SyntheticEnv


def make_env(name: str, **kwargs):
    """Dispatch by name ('synthetic' | 'peg') or external-suite spec
    ('gym:<id>' | 'dmc:<domain>:<task>' | 'robosuite:<Task>'); MuJoCo and
    the external suites import lazily."""
    if name == "synthetic":
        return SyntheticEnv(**kwargs)
    if name == "peg":
        from multimodal_rssm_torch.envs.peg import PegInsertionEnv

        return PegInsertionEnv(**kwargs)
    if ":" in name:
        from multimodal_rssm_torch.envs.zoo import make_zoo_env

        return make_zoo_env(name, **kwargs)
    raise ValueError(
        f"unknown env '{name}' (expected 'synthetic', 'peg', or a suite "
        "spec like 'gym:Pendulum-v1', 'dmc:cartpole:swingup', "
        "'robosuite:Lift')"
    )


__all__ = ["SyntheticEnv", "make_env"]
