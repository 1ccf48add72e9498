"""The reference's battery of streamed builds and grid-only serving,
`tests/test_streamed_build.py`, run against the port.

`port_battery` loads it with its imports of the JAX package pointed at
`nextplaid_tpu_torch`, and with these edits:
- `create_index`, `create_index_streamed`, `create_index_from_device`,
  `DeviceIndex.load` and `load_grid_only` given device="cpu";
- `import jax.numpy as jnp` -> `import torch`, `jnp.asarray(` ->
  `torch.as_tensor(` (the port's builds and searches take tensors), and
  `refine_own_topk_device` gets its numpy queries and mask as tensors too;
- the monkeypatched `container._device_hbm_bytes` takes the port's device
  argument (`lambda device: ...`);
- the asserts on `refine_tab`, the JAX package's device refine table
  (`ops/refine_gather.py`, which the port leaves out by design: its device
  refine gathers rows from the resident codes and residuals), assert the
  refine side instead: `go8.refine_tab is not None and go8.codes.shape[0]
  == 0` and `index.refine_tab is not None` -> `refine_side == "device"`,
  `go.refine_tab is None` -> `go.refine_side == "none"`.
Left out, as the port leaves out the JAX package's single-grid split
dispatch by design (ROADMAP, "Not ported, by design": `SPLIT_DISPATCH_SLOTS`;
the port's `exact_search_split` serves bucketed grids only):
`test_exact_search_split_matches_pipeline` and `test_mega_split_route_forced`.
"""

from tests.test_torch_api import expose, port_battery

_streamed = port_battery(
    "test_streamed_build",
    ("import jax.numpy as jnp\n", "import torch\n"),
    ("jnp.asarray(", "torch.as_tensor("),
    ('"_device_hbm_bytes", lambda: ', '"_device_hbm_bytes", lambda device: '),
    ("assert go8.refine_tab is not None and go8.codes.shape[0] == 0",
     'assert go8.refine_side == "device"'),
    ("assert index.refine_tab is not None", 'assert index.refine_side == "device"'),
    ("assert go.refine_tab is None", 'assert go.refine_side == "none"'),
    ("index, q_arr, q_mask, torch.as_tensor(cand), top_k=4",
     "index, torch.as_tensor(q_arr), torch.as_tensor(q_mask), torch.as_tensor(cand), top_k=4"),
    cpu_calls=("create_index", "create_index_streamed", "create_index_from_device",
               "DeviceIndex.load", "load_grid_only"),
)

LEFT_OUT = {"test_streamed_build": ("test_exact_search_split_matches_pipeline",
                                    "test_mega_split_route_forced")}
BATTERIES = {"test_streamed_build": (_streamed, expose(
    _streamed, globals(), LEFT_OUT["test_streamed_build"]))}


def test_battery_lists_every_reference_test():
    counts = {"test_streamed_build": 16}
    for name, (mod, tests) in BATTERIES.items():
        assert not set(tests) & set(LEFT_OUT.get(name, ()))
        assert len(tests) + len(LEFT_OUT.get(name, ())) == counts[name], name
