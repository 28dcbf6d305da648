"""``frames_per_s`` as a per-layer reading, in a cell where the tracker and
the hash-grid mapper take turns at the device lock on every frame: there
the race for the lock spreads it from run to run by more than an
end-to-end bound may allow, and it moves ``map_rays_per_s`` (a quicker
tracker leaves the mapper more of the card)."""
from portbench.harness import load_reader

read = load_reader("frames_per_s")
