"""Output-resolution post chain — the reference's upscaler + Final stage.

Reference (SURVEY.md §3.3, NRDSample.cpp:4236-4409): after composition/TAA the
frame runs at *render* resolution and is lifted to *output* resolution by
DLSS-SR/RR (NGX) or left native, then NIS sharpening, then the Final pass
(split-screen/debug/sRGB) writes the swapchain image.

Design: the NN upscalers are external SDK black boxes the reference links
against (SURVEY.md §2.3 "Upscalers" row — explicitly out of scope as NN);
this package provides the same *slots* with classical kernels expressed as
dense array programs:

  * ``upscale.lanczos_resize`` — the SR slot: separable Lanczos-2 resampling
    expressed as two dense matmuls (not gathers);
  * ``nis.sharpen``            — the NIS slot: contrast-adaptive sharpening;
  * ``guides.rr_guides``       — DlssBefore.cs.hlsl parity: the guide buffers a
    neural denoiser consumes (hw depth, diff/spec albedo, normal+roughness,
    denormalized spec hit distance), kept so a learned upscaler can be dropped
    into the slot later;
  * ``final.final_pass``       — Final.cs.hlsl parity: split-screen separator,
    dither, validation overlay, sRGB.
"""

from nrdsample_tpu.post import final, guides, nis, upscale  # noqa: F401
