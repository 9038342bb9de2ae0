"""Event kinds shared with the reference engines (copy of the
reference's core/event.py constants, cut to the port's slices).

Events are ordered by (time, dst, src, per-src seq); on the device a
host's heap row is sorted by (time, src<<32|seq).
"""

KIND_BOOT = 0     # host/process start
KIND_TIMER = 1    # self-scheduled timer
KIND_PACKET = 2   # packet delivery from the network model
KIND_STOP = 3     # process/host stop
# model NIC (experimental.model_bandwidth): a packet pops first as
# KIND_PACKET (the receive stage, host/model_nic.py) and re-fires as
# KIND_PACKET_READY at its post-serialization delivery time
KIND_PACKET_READY = 8
