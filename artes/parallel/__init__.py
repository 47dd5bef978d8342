from artes.parallel.mesh import (device_id_ranges, make_mesh,  # noqa: F401
                                 run_stream_mesh, sharded_dispatch)
