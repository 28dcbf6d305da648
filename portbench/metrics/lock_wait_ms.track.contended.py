"""``lock_wait_ms.track``, read the same way, in a cell where it moves
``map_rays_per_s``: where the tracker and the hash-grid mapper take
turns at the device lock on every frame, the mapper holds the card while
the tracker waits."""
from portbench.harness import load_reader

read = load_reader("lock_wait_ms.track")
