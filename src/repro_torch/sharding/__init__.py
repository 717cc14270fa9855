"""Distribution substrate (port of ``repro.sharding``): partition specs and
their DTensor placements, the ambient sharding context, and the
int8-compressed gradient exchange over ``torch.distributed``."""
