"""The port of ``example/memcost/``: where rematerialization saves
memory."""
