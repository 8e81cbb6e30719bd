"""Worker for the 2-process ``jax.distributed`` smoke test (run by
``tests/test_multihost.py``; SURVEY.md §2.3 P7 — multi-host bring-up).

Each process owns 4 faked CPU devices; together they form one 8-device
global mesh.  Exercises ``initialize_distributed`` (the multi-controller
bring-up), ``host_local_to_global`` (the per-host data-feed path), and a
cross-process ``psum``.
"""
import os
import sys


def main() -> int:
    port = sys.argv[1]
    pid = int(sys.argv[2])

    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4"
    ).strip()

    import jax

    # this test runs on faked CPU devices, never on an accelerator
    jax.config.update("jax_platforms", "cpu")

    import numpy as np
    from jax.sharding import PartitionSpec as P

    from points_matching.parallel.mesh import (
        DATA_AXIS,
        host_local_to_global,
        initialize_distributed,
        make_mesh,
    )

    initialize_distributed(
        coordinator_address=f"localhost:{port}", num_processes=2, process_id=pid
    )
    assert jax.process_count() == 2, jax.process_count()
    assert jax.process_index() == pid
    assert len(jax.devices()) == 8, len(jax.devices())
    assert len(jax.local_devices()) == 4

    mesh = make_mesh((8,), (DATA_AXIS,))

    # each process feeds its own host-local rows; global array = both
    local = np.full((4, 3), float(pid + 1), np.float32)
    g = host_local_to_global(mesh, P(DATA_AXIS, None), local)
    assert g.shape == (8, 3), g.shape

    # one psum across the processes: Σ rows = 4·3·1 + 4·3·2 = 36
    f = jax.jit(
        jax.shard_map(
            lambda x: jax.lax.psum(x.sum(), DATA_AXIS),
            mesh=mesh,
            in_specs=P(DATA_AXIS, None),
            out_specs=P(),
        )
    )
    tot = jax.device_get(f(g))
    np.testing.assert_allclose(np.asarray(tot), 36.0)

    jax.distributed.shutdown()
    print(f"MULTIHOST_OK {pid}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
