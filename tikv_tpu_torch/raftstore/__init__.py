"""The region metadata, the apply-path observer seam and the region-
clamped snapshot: the raftstore pieces the region lifecycle of the
columnar cache needs (``metapb``, ``observer``, ``peer.RegionSnapshot``).
"""
