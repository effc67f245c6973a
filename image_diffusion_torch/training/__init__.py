"""Stage-2 UNet training: data feeding and the trainer."""
