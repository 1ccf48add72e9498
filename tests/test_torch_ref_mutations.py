"""The reference's batteries of index mutations, run against the port:
`tests/test_update_delete.py` and `tests/test_device_append.py`.

`port_battery` loads each with its imports of the JAX package pointed at
`nextplaid_tpu_torch`, and with these edits:
- test_update_delete: `create_index`, `update`, `update_or_create` and
  `DeviceIndex.load` given device="cpu".
- test_device_append: `create_index`, `update_index`, `DeviceIndex.load`
  and `AppState` given device="cpu"; its unused `import jax.numpy` goes;
  in `test_append_capacity_growth_and_cache_stability` the two reads of
  `exact_search_pipeline._cache_size()` (the count of compiled XLA
  programs, which eager PyTorch does not have) read 0, so only its
  compile-count assert is void: the growth, the searches and the parity
  with a fresh load stay.
Left out: `test_api_ingest_uses_sharded_grid_append`, which already runs
against the port in tests/test_torch_api.py.
"""

from tests.test_torch_api import expose, port_battery

_update_delete = port_battery(
    "test_update_delete",
    cpu_calls=("create_index", "update", "update_or_create", "DeviceIndex.load"))
_device_append = port_battery(
    "test_device_append",
    ("import jax.numpy as jnp\n", ""),
    ("cache_before = exact_search_pipeline._cache_size()", "cache_before = 0"),
    ("cache_after = exact_search_pipeline._cache_size()", "cache_after = 0"),
    cpu_calls=("create_index", "update_index", "DeviceIndex.load", "AppState"))

LEFT_OUT = {"test_device_append": ("test_api_ingest_uses_sharded_grid_append",)}
BATTERIES = {
    "test_update_delete": (_update_delete, expose(_update_delete, globals())),
    "test_device_append": (_device_append, expose(
        _device_append, globals(), LEFT_OUT["test_device_append"])),
}


def test_battery_lists_every_reference_test():
    counts = {"test_update_delete": 9, "test_device_append": 9}
    for name, (mod, tests) in BATTERIES.items():
        assert not set(tests) & set(LEFT_OUT.get(name, ()))
        assert len(tests) + len(LEFT_OUT.get(name, ())) == counts[name], name
