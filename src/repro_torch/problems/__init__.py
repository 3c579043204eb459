"""Problem builders for the port: EA3D instance sets, Max-Cut, 3SAT and
planted instances; ports of ``repro.problems`` (host numpy, the
reference's operations, so the same seeds give the same graphs)."""
