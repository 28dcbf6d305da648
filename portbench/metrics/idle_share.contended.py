"""``idle_share``, read the same way, in a cell where it moves
``map_rays_per_s``: where the tracker and the hash-grid mapper take
turns at the device lock on every frame, a tracker that is quicker leaves
the mapper more of the card."""
from portbench.harness import load_reader

read = load_reader("idle_share")
