"""The device's idle share between training updates, in %: the device
gaps from one update's ``update`` end mark to the next update's start
mark, summed, over the summed distances between their start marks, for
updates with no profiler running. A gap holds the loader's gather of the
next batch. The set-up's pauses (the host-card copies before the window)
are left out as pairs more than ten times the median distance apart."""

from perfbench import marks


def read(ctx):
  del ctx
  return marks.idle_share("update")
