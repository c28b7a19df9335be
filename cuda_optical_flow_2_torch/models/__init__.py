"""Flow pipelines: pyramidal Lucas-Kanade and its streaming loop."""
