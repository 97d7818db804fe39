"""One-off measurement: the port's ``.msgpack`` reader on a full-width file.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_port_fixtures/time_full_width_read.py [OUT_DIR]

Writes a default-configuration, full-width TrainState (the reference's
widths: 66.5 M parameters, Adam's two moments, its count) with the JAX
package's ``save_checkpoint``, reads it with the port's
``io/flax_msgpack.load`` and with ``flax.serialization.msgpack_restore``,
checks the two leaf for leaf, and prints one JSON line of the file's size
and each reader's seconds (median of 3).  The weights come from the port's
model through the JAX package's reference importer, pure layout transforms
(no model is traced or run); the moments are seeded random arrays.  Not a
tier-1 test: it needs ~4 GB of host memory and a card's machine has no
flax to write the file.
"""

import json
import os
import statistics
import sys
import tempfile
import time

import jax
import numpy as np
import optax
from flax import serialization

from multimodal_rssm_tpu.core.config import compose as jax_compose
from multimodal_rssm_tpu.io import checkpoint as jckpt
from multimodal_rssm_tpu.io.torch_import import import_world_model
from multimodal_rssm_tpu.models.world_model import WorldModel as JaxWM
from multimodal_rssm_tpu.train import trainer as jtr

from multimodal_rssm_torch.core.config import compose
from multimodal_rssm_torch.io import flax_msgpack
from multimodal_rssm_torch.io.torch_export import reference_state_dict
from multimodal_rssm_torch.models.world_model import WorldModel


def _same(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and np.array_equal(got, want), path
    else:
        assert got == want, path


def main(out_dir: str) -> dict:
    port = WorldModel.from_config(compose())
    variables = import_world_model(reference_state_dict(port),
                                   JaxWM.from_config(jax_compose()))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    rng = np.random.default_rng(0)
    opt_state = jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(np.shape(x)).astype(np.float32)
                   if np.ndim(x) else np.asarray(7, np.int32)),
        jtr.build_optimizer(jax_compose()).init(params))
    state = jtr.TrainState(step=np.asarray(7, np.int32), params=params,
                           batch_stats=variables.get("batch_stats", {}),
                           opt_state=opt_state)
    path = jckpt.save_checkpoint(out_dir, 7, state)
    del state, opt_state, params, variables, port

    def timed(fn):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn()
            times.append(time.perf_counter() - t0)
            del out
        return statistics.median(times)

    def flax_read():
        with open(path, "rb") as f:
            return serialization.msgpack_restore(f.read())

    _same(flax_msgpack.load(path), flax_read())
    size = os.path.getsize(path)
    port_s, flax_s = timed(lambda: flax_msgpack.load(path)), timed(flax_read)
    n = sum(np.size(x) for x in jax.tree_util.tree_leaves(
        flax_msgpack.load(path)["state"]["params"]))
    return {"file_MB": size / 1e6, "parameters": int(n),
            "port_read_s": port_s, "port_MB_per_s": size / 1e6 / port_s,
            "flax_read_s": flax_s, "leaf_for_leaf_equal": True,
            "optax_version": optax.__version__}


if __name__ == "__main__":
    with tempfile.TemporaryDirectory(dir=sys.argv[1] if len(sys.argv) > 1
                                     else None) as tmp:
        print(json.dumps(main(tmp)))
