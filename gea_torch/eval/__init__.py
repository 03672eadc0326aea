"""Evaluation of the port (port of `gea/eval/`): the labelled proxy-FID,
KID and precision/recall over a frozen random-feature network
(`gea_torch.eval.fid`)."""
