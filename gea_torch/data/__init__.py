"""The trainer's input pipeline (`gea/data/` is the reference): datasets
(with `gea`'s native C++ JPEG loader), preprocess on the host or on the
device, prefetch and the device-resident dataset cache."""
