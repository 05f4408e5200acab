"""Least time of an iteration's convolutions over the device time of
cuDNN's kernels, picked by kernel name (%): every kernel whose name holds
`cudnn` (its convolutions and their layout conversions), whatever
launched it, a CUDA graph's replay included. `conv_roofline.env_steps`
counts the device time under the `aten::convolution` operators instead,
and a graph's kernels run under no operator."""


def read(run):
  p = run.profile
  least = (run.model or {}).get("conv_least_s_per_iteration")
  if not p or not p.get("units") or not least:
    return None
  seconds = sum(s for name, s in p.get("op_device_s", {}).items()
                if "cudnn" in name.lower() and not name.startswith("aten::"))
  if not seconds:
    return None
  return 100.0 * least / (seconds / p["units"])
